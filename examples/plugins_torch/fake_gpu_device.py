#!/usr/bin/env python
"""Example external device plugin: advertises two fake GPUs.

Drop in the agent's plugin_dir (reference: an external device plugin
binary built against plugins/device, like the NVIDIA plugin)."""

from nomad_tpu_torch.plugins import DevicePlugin, serve_device
from nomad_tpu_torch.structs import NodeDeviceResource


class FakeGPUPlugin(DevicePlugin):
    name = "fake-gpu"

    def fingerprint(self):
        return [NodeDeviceResource(
            vendor="acme", type="gpu", name="fake100",
            instance_ids=["fake100-0", "fake100-1"],
            attributes={"memory": "16384", "cores": "1024"})]

    def reserve(self, device_ids):
        return {"envs": {"ACME_VISIBLE_DEVICES": ",".join(device_ids)},
                "mounts": [], "devices": []}


if __name__ == "__main__":
    serve_device(FakeGPUPlugin())
