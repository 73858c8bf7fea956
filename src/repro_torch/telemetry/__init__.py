"""repro_torch.telemetry — the serve-report renderer (a copy of the
reference's). Metrics, spans and timeline export are a later slice."""
from repro_torch.telemetry.report import render_report  # noqa: F401
