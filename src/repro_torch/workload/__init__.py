"""repro_torch.workload — the trace-driven workload harness of the port:
the JSONL trace format (a copy of the reference's), the deterministic
generators of production traffic shapes (drawn with the port's threefry,
byte-identical to the reference's traces), the KV-write-pressure ramp,
and trace replay, recording and the report joiner."""
from repro_torch.workload.generators import (PRESETS,  # noqa: F401
                                             make_workload)
from repro_torch.workload.pressure import (assert_monotone,  # noqa: F401
                                           build_ramp, pressure_score)
from repro_torch.workload.replay import (TraceSource,  # noqa: F401
                                         join_reports, record_requests,
                                         requests_from_trace)
from repro_torch.workload.trace import (TRACE_VERSION, Trace,  # noqa: F401
                                        TraceEvent, load_trace, save_trace,
                                        validate_trace)
