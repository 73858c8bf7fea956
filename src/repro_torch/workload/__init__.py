"""repro_torch.workload — the JSONL trace format (a copy of the reference's)
and trace replay into the scheduler. Trace generators wait for the
threefry ``randint`` port."""
from repro_torch.workload.replay import TraceSource  # noqa: F401
from repro_torch.workload.trace import (TRACE_VERSION, Trace,  # noqa: F401
                                        TraceEvent, load_trace, save_trace,
                                        validate_trace)
