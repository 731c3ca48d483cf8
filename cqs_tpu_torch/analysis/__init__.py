"""Analysis layer: call-graph analytics and context assembly."""

from cqs_tpu_torch.analysis.callgraph import (  # noqa: F401
    CallGraph, ImpactReport, analyze_impact, find_dead_code, test_map, trace_path,
)
from cqs_tpu_torch.analysis.gather import GatherItem, gather  # noqa: F401
