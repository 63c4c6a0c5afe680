"""Runtime counters (`metrics`), the GPU profiling helpers (`profiling`),
structured logging (`logging`: `get_logger`, `log_event`), the build of the
host C++ libraries (`native_build`) and the HTTP float-mode renderer
(`jsonfmt`)."""
from .logging import get_logger, log_event

__all__ = ["get_logger", "log_event"]
