from .plot import contribution_function, dashboard
from .telemetry import (SolveMetrics, enable_nan_debugging, flux_balance,
                        profile_trace, progress_printer, use_compile_cache)
