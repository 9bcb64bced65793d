"""The conformance scenario×policy matrix.

The scenario axis is *derived from the suite registry*
(``repro_torch.dataflows.suite``): registering a new scenario automatically
enrolls it in the conformance matrix — no second list to keep in sync.
The policy axis covers the three mechanism classes whose event streams
exercise distinct engine code paths:

* ``lru``     baseline replacement (fills/evictions/write-backs only)
* ``dbp``     dead-block prediction (TMU retirements drive victims)
* ``at+dbp``  anti-thrashing tiers composed with DBP
* ``all``     adds the dynamic bypass gear (gear-transition events);
              kept out of the default matrix axis only where noted

CI runs the smoke subset (one small, one paged, one multi-tenant
scenario — the three trace shapes with structurally different event
mixes); the full matrix backs the frozen goldens.
"""

from __future__ import annotations

from typing import Iterable
from typing import Iterator
from typing import Optional
from typing import Tuple

#: policy axis of the frozen golden matrix (the acceptance floor:
#: lru, dbp, at+dbp) plus the gear-exercising composite
CONFORMANCE_POLICIES: Tuple[str, ...] = ("lru", "dbp", "at+dbp", "all")

#: CI smoke subset: small dense, paged-decode, multi-tenant composed,
#: and generator-driven replay traces — the structurally distinct event
#: mixes (serve-replay adds mid-run tensor churn from the batching loop;
#: serve-replay-pooled additionally recycles addresses, so dense-id and
#: owner attribution must survive cross-generation address reuse)
SMOKE_SCENARIOS: Tuple[str, ...] = ("matmul", "decode-paged", "mt-spec-ssd",
                                    "serve-replay", "serve-replay-pooled")


def matrix_entries(smoke: bool = False,
                   scenarios: Optional[Iterable[str]] = None,
                   policies: Optional[Iterable[str]] = None,
                   ) -> Iterator[Tuple[str, str]]:
    """Yield ``(scenario_key, policy_name)`` pairs of the conformance
    matrix.  Default: every registered suite scenario × every
    conformance policy; ``smoke=True`` restricts scenarios to the CI
    subset; explicit ``scenarios``/``policies`` override either axis."""
    if scenarios is None:
        if smoke:
            scenarios = SMOKE_SCENARIOS
        else:
            from ..dataflows.suite import registry_keys
            scenarios = registry_keys()
    if policies is None:
        policies = CONFORMANCE_POLICIES
    policies = tuple(policies)
    for key in scenarios:
        for pol in policies:
            yield key, pol
