"""CloudPowerCap orchestrator facade over
:class:`repro_torch.core.manager_core.ManagerCore`, the entry point the
simulators drive.  Baselines from the paper's evaluation (``Static``,
``StaticHigh``) run the same pipeline with cap changes disabled.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.core.manager_core import (InvocationResult, ManagerConfig,
                                           ManagerCore)
from repro_torch.drs.snapshot import ClusterSnapshot

__all__ = ["CloudPowerCapManager", "InvocationResult", "ManagerConfig",
           "ManagerCore", "static_manager"]


class CloudPowerCapManager:
    """Drives one cluster; stateless between invocations except config.
    ``device=None`` runs its kernels on the GPU."""

    def __init__(self, config: Optional[ManagerConfig] = None, device=None):
        self.core = ManagerCore(config, device)

    @property
    def config(self) -> ManagerConfig:
        return self.core.config

    @property
    def device(self):
        return self.core.device

    def run_invocation(self, snapshot: ClusterSnapshot, now: float = 0.0,
                       low_since: Optional[dict] = None,
                       last_config_change: float = -1e18,
                       limits=None) -> InvocationResult:
        return self.core.invoke(snapshot, now=now, low_since=low_since,
                                last_config_change=last_config_change,
                                limits=limits)


def static_manager(dpm_enabled: bool = True,
                   device=None) -> CloudPowerCapManager:
    """Static / StaticHigh baseline: caps never change after deployment."""
    return CloudPowerCapManager(ManagerConfig(
        powercap_enabled=False, dpm_enabled=dpm_enabled), device)
