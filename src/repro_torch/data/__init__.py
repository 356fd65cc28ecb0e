"""The paper's evaluation workloads (the port of ``repro.data``)."""

from repro_torch.data.workloads import PaperWorkload, paper_workloads

__all__ = ["paper_workloads", "PaperWorkload"]
