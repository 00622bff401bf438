"""tpuserver_torch.perfanalyzer: the port's load generator and profiler.

The port's copy of ``perfanalyzer`` (the Python port of the reference
``perf_analyzer``, SURVEY.md §2.2, §3.4), bound to
``tpuserver_torch.core`` and CUDA regions: the in-process client backend
and the HTTP and gRPC ones (the standard library and the port's gRPC
messages, no ``tritonclient``), concurrency and request-rate load
managers, a measurement-window profiler with 3-consecutive-window
stability detection and client/server stat merging, a generation mode
reporting token-level metrics (TTFT, ITL, tokens/sec), and a report
writer (stdout table / CSV / JSON rows, key for key the JAX tool's).  It
imports nothing of JAX, ``tpuserver``, ``perfanalyzer`` or
``tritonclient``; torch only where a CUDA region is touched (and through
the core it drives).

Entry points:

- :func:`tpuserver_torch.perfanalyzer.client_backend.create_backend` —
  backend factory (``inprocess``, ``http``, ``grpc``)
- :class:`~tpuserver_torch.perfanalyzer.load_manager.ConcurrencyManager` /
  :class:`~tpuserver_torch.perfanalyzer.load_manager.RequestRateManager`
- :class:`~tpuserver_torch.perfanalyzer.profiler.InferenceProfiler`
- :class:`~tpuserver_torch.perfanalyzer.generation.GenerationProfiler`
- :class:`~tpuserver_torch.perfanalyzer.report.ReportWriter`
- :class:`~tpuserver_torch.perfanalyzer.coordinator.Coordinator` /
  :class:`~tpuserver_torch.perfanalyzer.coordinator.WorkerChannel` —
  the distributed mode's barrier-synchronized windows (``--workers``)
- ``python -m tpuserver_torch.perf_analyzer`` — the CLI that wires them
  together
"""

from tpuserver_torch.perfanalyzer.client_backend import (
    ClientBackend,
    create_backend,
)
from tpuserver_torch.perfanalyzer.coordinator import (
    Coordinator,
    WorkerChannel,
    merge_windows,
    merge_worker_windows,
    reap_workers,
)
from tpuserver_torch.perfanalyzer.generation import GenerationProfiler
from tpuserver_torch.perfanalyzer.load_manager import (
    ConcurrencyManager,
    LoadCollector,
    RequestRateManager,
)
from tpuserver_torch.perfanalyzer.metrics import (
    latency_summary,
    merge_window_records,
    percentile,
    server_stats_delta,
    server_stats_snapshot,
)
from tpuserver_torch.perfanalyzer.profiler import InferenceProfiler
from tpuserver_torch.perfanalyzer.report import ReportWriter
from tpuserver_torch.perfanalyzer.schedule import schedule_distribution
from tpuserver_torch.perfanalyzer.stability import StabilityDetector

__all__ = [
    "ClientBackend",
    "ConcurrencyManager",
    "Coordinator",
    "GenerationProfiler",
    "InferenceProfiler",
    "LoadCollector",
    "RequestRateManager",
    "ReportWriter",
    "StabilityDetector",
    "WorkerChannel",
    "create_backend",
    "latency_summary",
    "merge_window_records",
    "merge_windows",
    "merge_worker_windows",
    "percentile",
    "reap_workers",
    "schedule_distribution",
    "server_stats_delta",
    "server_stats_snapshot",
]
