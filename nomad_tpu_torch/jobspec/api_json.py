"""JSON jobspec (api.Job wire shape) -> structs.Job.

The heavy lifting is the generic wire codec (`structs.codec`); this module
adds the canonicalization the reference applies on register
(`Job.Canonicalize` in the api/ package): defaulted IDs/names, group counts,
task resource defaults.
"""

from __future__ import annotations

from typing import Any, Dict

from nomad_tpu_torch.structs import Job
from nomad_tpu_torch.structs.codec import decode


def job_from_api_dict(obj: Dict[str, Any]) -> Job:
    job = decode(Job, obj)
    if not job.id:
        job.id = job.name
    if not job.name:
        job.name = job.id
    for tg in job.task_groups:
        if tg.count <= 0:
            tg.count = 1
        if not tg.name:
            tg.name = "group"
    return job
