"""HyPar core — the paper's hybrid-parallelisation job model in PyTorch.

Public API::

    from repro_torch.core import (
        DataChunk, ChunkedData, ChunkRef, Job, ParallelSegment, JobGraph,
        FunctionRegistry, parse_job_text, parse_job_file,
        VirtualCluster, LocalExecutor, SpmdExecutor, IterativeSpec,
        FaultInjector, ChaosLocalExecutor, JobStore, job_key,
        ProcessExecutor,
    )

Workers sit on CUDA devices unless the caller passes others
(``VirtualCluster(devices=[torch.device("cpu")])``).  The durable runtime is
:class:`JobStore` (sqlite, the JAX package's schema) under
:class:`ProcessExecutor` (spawned worker processes).
"""
from .job import (ChunkedData, ChunkRef, DataChunk, GraphValidationError, Job,
                  JobGraph, ParallelSegment)
from .registry import ControlContext, FunctionKind, FunctionRegistry
from .parser import format_job_text, parse_job_file, parse_job_text
from .scheduler import (CostModelParams, MasterScheduler, Placement,
                        ResultStore, SchedulerProc, VirtualCluster, Worker)
from .executor import (BaseExecutor, ChunkBlocks, ExecutionReport,
                       IterativeSpec, LocalExecutor, SpmdExecutor,
                       run_while_loop)
from .fault import ChaosLocalExecutor, FaultInjector, Heartbeat
from .store import JobStore, job_key
from .procworker import ProcessExecutor, WorkerFunctionError

__all__ = [
    "ChunkedData", "ChunkRef", "DataChunk", "GraphValidationError", "Job",
    "JobGraph", "ParallelSegment", "ControlContext", "FunctionKind",
    "FunctionRegistry", "format_job_text", "parse_job_file", "parse_job_text",
    "BaseExecutor", "CostModelParams", "MasterScheduler", "Placement",
    "ResultStore", "SchedulerProc",
    "VirtualCluster", "Worker", "ExecutionReport", "IterativeSpec",
    "LocalExecutor", "SpmdExecutor", "ChunkBlocks", "run_while_loop",
    "ChaosLocalExecutor",
    "FaultInjector", "Heartbeat", "JobStore", "job_key", "ProcessExecutor",
    "WorkerFunctionError",
]
