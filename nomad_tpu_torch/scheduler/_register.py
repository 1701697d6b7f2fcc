"""Built-in scheduler registration (reference: scheduler.BuiltinSchedulers);
importing this module wires the factory map."""

from .base import register_scheduler
from .core_sched import new_core_scheduler
from .generic import new_batch_scheduler, new_service_scheduler
from .system import new_sysbatch_scheduler, new_system_scheduler

register_scheduler("service", new_service_scheduler)
register_scheduler("service-tpu", new_service_scheduler)
register_scheduler("batch", new_batch_scheduler)
register_scheduler("batch-tpu", new_batch_scheduler)
register_scheduler("system", new_system_scheduler)
register_scheduler("sysbatch", new_sysbatch_scheduler)
register_scheduler("_core", new_core_scheduler)
