"""Multi-tenant cluster scheduling control plane: the port's copy of
kubeflow_tpu/scheduler (stdlib only; the port imports nothing of the JAX
package).  Decisions, metric names, span names, fault sites and
condition reasons are the JAX package's; chip counts come from the
port's GPU shapes (runtime/topology.py).

The policy layer BETWEEN submitted ``TPUJob`` CRs and the gang placer
(``operator/gang.py``).  The gang scheduler answers "does this job's
full slice demand fit right now"; this package answers "which job
should be offered next, whose claim should be revoked, and why" —
per-tenant quotas, weighted-fair ordering, strict priority classes,
conservative backfill, and preemption-with-resume.  Both *Gavel*
(heterogeneity-aware cluster scheduling) and the speculative-container
scheduling line of work locate the win exactly here: a policy core
above the placer, not a smarter placer.

Layout:
    policy.py   SchedulerConfig + the admission-plan engine
    queue.py    persistent pending-queue bookkeeping + ClusterScheduler
                (the facade the reconciler consults)
    preempt.py  victim selection + the preemption rate limiter
    fuse.py     horizontal fusion: fold fusable singleton swarms into
                one gang (the HFTA admission tier; runtime/hfta.py is
                the training half)
    colocate.py train/serve colocation: the fleet autoscaler's desired
                replicas as a high-priority ServingClaim on the SAME
                pool (elastic grow/shrink, short-grace preemption,
                speculative prepull)
"""

from kubeflow_tpu_torch.scheduler.colocate import (  # noqa: F401
    LABEL_DEPLOYMENT,
    LABEL_WORKLOAD,
    SERVING_PRIORITY,
    SERVING_TENANT,
    WORKLOAD_SERVING,
    ServingClaimClient,
    build_claim_cr,
    claim_key,
    claim_name,
)
from kubeflow_tpu_torch.scheduler.fuse import (  # noqa: F401
    LABEL_FUSE_FAMILY,
    fold_pending,
    fused_gang_key,
    fused_gang_name,
)
from kubeflow_tpu_torch.scheduler.policy import (  # noqa: F401
    DEFAULT_PRIORITY_CLASSES,
    LABEL_PRIORITY,
    LABEL_TENANT,
    Decision,
    JobView,
    Plan,
    SchedulerConfig,
    SchedulingPolicy,
    tenant_shares,
)
from kubeflow_tpu_torch.scheduler.preempt import (  # noqa: F401
    PreemptionConfig,
    PreemptionRateLimiter,
    pick_victims,
)
from kubeflow_tpu_torch.scheduler.queue import (  # noqa: F401
    ClusterScheduler,
    SchedulerQueue,
)
