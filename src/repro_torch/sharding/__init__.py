"""Logical-axis sharding rules (MaxText-style) for a ``torch.distributed``
device mesh, as the JAX package's ``repro.sharding``.

Model code names tensors' *logical* axes ("dp", "tp", …); :func:`use_mesh`
binds a mesh, the rules translate the names into specs, and the model's
layout moves (``constrain``, ``comm``) run the collectives the specs call
for.  Without a bound mesh every move is a no-op, so single-device runs are
unchanged.
"""

from .api import ACT_SEQ
from .api import LOGICAL_RULES
from .api import NamedSharding
from .api import ShapeMesh
from .api import Stream
from .api import act_axes
from .api import constrain
from .api import current_mesh
from .api import current_stream
from .api import logical_spec
from .api import named_sharding
from .api import placements
from .api import use_mesh
from .api import use_stream
from .state import gather_tree
from .state import shard_tree
from .state import shardings_for

__all__ = ["ACT_SEQ", "LOGICAL_RULES", "NamedSharding", "ShapeMesh", "Stream", "act_axes",
           "constrain", "current_mesh", "current_stream", "gather_tree", "logical_spec",
           "named_sharding", "placements", "shard_tree", "shardings_for", "use_mesh",
           "use_stream"]
