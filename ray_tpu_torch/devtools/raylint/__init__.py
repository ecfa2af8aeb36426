"""raylint — the repo's invariant-enforcing static-analysis suite.

Eight AST rules distilled from five PRs of postmortems, plus a dynamic
lock-order witness (``RAY_TPU_TORCH_LOCKWITNESS=1``).  ``python -m ray_tpu_torch lint`` runs
the static half; ``tests/test_torch_raylint.py`` gates both in tier-1.

Rule registry (id -> check callable):

====  =======================  ================================================
R1    protocol-consistency     every sent wire frame has a dispatch arm (and
                               no dead arms), in both wire directions
R2    exception-shadow         broad ``except`` arms that kill narrower ones
R3    hot-path-entropy         uuid4/urandom/secrets on the dispatch path
R4    lock-scope-weight        blocking/table-sized work under a held lock
R5    unbounded-container      head-resident dict/list that grows forever
R6    event-source-registry    ``events.emit`` sources declared in
                               ``KNOWN_SOURCES``
R7    state-api-parity         ``list_*`` helpers with a head handler AND an
                               operator surface
R8    bare-thread-hygiene      ``threading.Thread`` with neither ``daemon=``
                               nor a join
====  =======================  ================================================
"""

from ray_tpu_torch.devtools.raylint.core import (  # noqa: F401
    Finding, LintConfig, Project, baseline_path, load_baseline,
    save_baseline, split_new,
)
from ray_tpu_torch.devtools.raylint.rules_protocol import (
    check_event_sources, check_protocol, check_state_parity,
)
from ray_tpu_torch.devtools.raylint.rules_exceptions import check_exception_shadow
from ray_tpu_torch.devtools.raylint.rules_hotpath import (
    check_bare_threads, check_hot_path_entropy,
)
from ray_tpu_torch.devtools.raylint.rules_locking import check_lock_scope_weight
from ray_tpu_torch.devtools.raylint.rules_containers import (
    check_unbounded_containers,
)

RULES = {
    "R1": check_protocol,
    "R2": check_exception_shadow,
    "R3": check_hot_path_entropy,
    "R4": check_lock_scope_weight,
    "R5": check_unbounded_containers,
    "R6": check_event_sources,
    "R7": check_state_parity,
    "R8": check_bare_threads,
}

from ray_tpu_torch.devtools.raylint.runner import (  # noqa: E402,F401
    GateResult, analyze, run_gate,
)
