"""The single-host multi-tenant serving fleet (``bigdl_tpu/serving/fleet``,
its first round): several models behind one admission plane, priority and
deadline classes, SLO-driven autoscaling.

One admission plane fronts N tenants, each a model with its own bucket
ladder, packed quantized copy or ``ContinuousGenerator``, registered and
deregistered live (:mod:`.registry`); every request carries its
``(tenant, priority_class, deadline_class)`` triple; a weighted-fair stride
dispatcher with a starvation bound picks the next tenant
(:mod:`.dispatch`); and a control loop grows and shrinks each tenant's
worker allocation from its SLO burn and backlog, with hysteresis and a
cooldown, running a tenant's rungs on a worker before traffic reaches it
(:mod:`.autoscaler`).

Entry points: :class:`FleetServer` (:mod:`.server`), the drill's phase 12
(``python -m bigdl_tpu_torch.cli serve-drill``, ``--fleet-smoke`` alone)
and ``bench-serve --fleet`` (:mod:`.bench_fleet`).  The cross-host cluster
and the live rollout are later parts of the port (``ROADMAP.md`` Queue 1
item 13, parts 3b and 3c).
"""

from bigdl_tpu_torch.serving.fleet.autoscaler import Autoscaler
from bigdl_tpu_torch.serving.fleet.dispatch import StrideScheduler
from bigdl_tpu_torch.serving.fleet.registry import (GenerativeTenant,
                                                    ModelRegistry, Tenant,
                                                    TenantSpec)
from bigdl_tpu_torch.serving.fleet.server import FleetServer, FleetWorker

__all__ = ["FleetServer", "FleetWorker", "TenantSpec", "Tenant",
           "GenerativeTenant", "ModelRegistry", "StrideScheduler",
           "Autoscaler"]
