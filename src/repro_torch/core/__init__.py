"""HyPar core — the paper's hybrid-parallelisation job model in PyTorch.

Public API::

    from repro_torch.core import (
        DataChunk, ChunkedData, ChunkRef, Job, ParallelSegment, JobGraph,
        FunctionRegistry, parse_job_text, parse_job_file,
        VirtualCluster, LocalExecutor, SpmdExecutor, IterativeSpec,
        FaultInjector, ChaosLocalExecutor,
    )

Workers sit on CUDA devices unless the caller passes others
(``VirtualCluster(devices=[torch.device("cpu")])``).  The durable runtime
(a persistent job store and process workers) is not ported yet.
"""
from .job import (ChunkedData, ChunkRef, DataChunk, GraphValidationError, Job,
                  JobGraph, ParallelSegment)
from .registry import ControlContext, FunctionKind, FunctionRegistry
from .parser import format_job_text, parse_job_file, parse_job_text
from .scheduler import (CostModelParams, MasterScheduler, Placement,
                        ResultStore, SchedulerProc, VirtualCluster, Worker)
from .executor import (BaseExecutor, ExecutionReport, IterativeSpec,
                       LocalExecutor, SpmdExecutor, run_while_loop)
from .fault import ChaosLocalExecutor, FaultInjector, Heartbeat

__all__ = [
    "ChunkedData", "ChunkRef", "DataChunk", "GraphValidationError", "Job",
    "JobGraph", "ParallelSegment", "ControlContext", "FunctionKind",
    "FunctionRegistry", "format_job_text", "parse_job_file", "parse_job_text",
    "BaseExecutor", "CostModelParams", "MasterScheduler", "Placement",
    "ResultStore", "SchedulerProc",
    "VirtualCluster", "Worker", "ExecutionReport", "IterativeSpec",
    "LocalExecutor", "SpmdExecutor", "run_while_loop", "ChaosLocalExecutor",
    "FaultInjector", "Heartbeat",
]
