"""Roofline terms of a step on the H100: the counterpart of the JAX
package's ``repro.distributed.hlo_analysis``.

``Roofline`` has the reference's fields and properties; its rates are the
card's, from NVIDIA's H100 SXM data sheet (dense, without sparsity; at the
700 W power limit):

  PEAK_FLOPS   989e12 FLOP/s, bf16 on the tensor cores (the step's FLOPs
               are held to it whatever their dtype, as the reference holds
               its HLO's FLOPs to one bf16 peak)
  HBM_BW       3.35e12 B/s, the 80 GB of HBM3
  PEAK_FLOPS_TF32  495e12 FLOP/s, TF32 on the tensor cores; fp32 work
               that splits each product into three TF32 ones (flash's
               gradient kernel) runs at most at a third of it
  LINK_BW      450e9 B/s per direction a GPU, NVLink 4 (900 GB/s both
               ways) to the other cards of one host

Collectives between hosts run over the network, slower than NVLink, so
``t_collective`` is a lower bound on a mesh that spans hosts. Global
collective bytes = per-card bytes x cards, so the two forms of the
collective term agree: global / (cards x link) == per-card / link.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

PEAK_FLOPS = 989e12        # bf16 FLOP/s a card, dense (H100 SXM data sheet)
HBM_BW = 3.35e12           # bytes/s a card (H100 SXM data sheet)
LINK_BW = 450e9            # bytes/s a card, each way (NVLink 4)
# peak by the dtype of the operations (fp32 outside the tensor cores)
PEAK_FLOPS_BY_DTYPE = {"bfloat16": PEAK_FLOPS, "float32": 67e12}
PEAK_FLOPS_TF32 = 495e12   # TF32 FLOP/s on the tensor cores, dense
# fp32 products taken as three TF32 ones (hi.hi' + hi.lo' + lo.hi'): the
# peak of fp32 work on the tensor cores at about fp32's accuracy
PEAK_FLOPS_SPLIT_TF32 = PEAK_FLOPS_TF32 / 3


@dataclass
class Roofline:
    flops_per_device: float
    hbm_bytes_per_device: float
    collective_bytes_per_device: float
    chips: int
    model_flops: float = 0.0      # 6·N·D (train) or 2·N_active·D (serve)
    collectives: Dict[str, int] = field(default_factory=dict)

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes_per_device / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes_per_device / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def model_flops_ratio(self) -> float:
        """useful model FLOPs / counted FLOPs (global)."""
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Achievable fraction of peak FLOP/s at the bound, counting only
        useful model FLOPs: (model_flops/chips/peak) / t_bound."""
        if self.t_bound == 0:
            return 0.0
        return (self.model_flops / self.chips / PEAK_FLOPS) / self.t_bound

    def mfu(self, step_s: float) -> float:
        """Model-FLOP utilization of a step measured at ``step_s`` seconds:
        model_flops / chips / (step_s x PEAK_FLOPS)."""
        return self.model_flops / self.chips / (step_s * PEAK_FLOPS)

    def to_dict(self) -> dict:
        return {
            "flops_per_device": self.flops_per_device,
            "hbm_bytes_per_device": self.hbm_bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "chips": self.chips,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops_ratio": self.model_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "collectives": self.collectives,
        }
