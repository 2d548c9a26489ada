"""Runtime: fault-tolerant step supervision."""
from repro_torch.runtime.supervisor import (FaultInjector,
                                            SimulatedDeviceFailure,
                                            Supervisor, SupervisorEvents)

__all__ = ["FaultInjector", "SimulatedDeviceFailure", "Supervisor",
           "SupervisorEvents"]
