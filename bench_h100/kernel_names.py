"""Which device kernel stands for which of the port's hand-written kernels
(K1-K10), by the name the profiler prints.

A frozen copy of `hept_tpu_torch/utils/profiling.py:PORT_KERNELS` and
`port_kernel` (the kernels of `hept_tpu_torch/csrc/*.cu`, all in an
anonymous namespace). A kernel that a later change adds under another name
maps to nothing, and the metrics that read a kernel's time then read
nothing for it.
"""

from __future__ import annotations

import re

PORT_KERNELS = {"tc_fwd_kernel": "K1", "tc_bwd_kernel": "K2", "fwd_kernel": "K1",
                "bwd_kernel": "K2", "gather_kernel": "K3", "gather1_kernel": "K3",
                "segment_sum_kernel": "K4", "row_gather_kernel": "K5",
                "row_gather_staged_kernel": "K5", "cols_fwd_kernel": "K6",
                "tc_cols_fwd_kernel": "K6", "cols_fwd_tiled_kernel": "K6",
                "cols_bwd_kernel": "K7", "tc_cols_bwd_kernel": "K7",
                "cols_bwd_tiled_kernel": "K7"}
_RE = re.compile(r"anonymous namespace\)::(" + "|".join(PORT_KERNELS) + r")\b(?:<([^>]*)>)?")
# the column kernels that K10 instantiates on the row layout (last template
# argument ROWS true)
_ROW_LAYOUT = ("cols_fwd_kernel", "cols_bwd_kernel", "cols_fwd_tiled_kernel",
               "cols_bwd_tiled_kernel")


def port_kernel(name: str) -> str | None:
    """"K1".."K10" for a kernel of the port by its profiler name, else None."""
    m = _RE.search(name)
    if m is None:
        return None
    if m.group(1) in _ROW_LAYOUT and (m.group(2) or "").split(",")[-1].strip() == "true":
        return "K10"
    return PORT_KERNELS[m.group(1)]
