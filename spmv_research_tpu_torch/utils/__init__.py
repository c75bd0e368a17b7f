from . import roofline
from . import timing
from . import plot
from .trace import trace_region, start_profiler, stop_profiler, profile
