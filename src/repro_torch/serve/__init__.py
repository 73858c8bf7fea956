"""repro_torch.serve — engine, slot pool and continuous scheduler."""
from repro_torch.serve.engine import ServeConfig, ServingEngine  # noqa: F401
from repro_torch.serve.scheduler import (  # noqa: F401
    ArrivalQueue, ContinuousScheduler, Request, synthetic_requests)
from repro_torch.serve.slots import SlotPool  # noqa: F401
