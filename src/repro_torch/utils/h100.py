"""The NVIDIA H100 80GB HBM3's data-sheet rates (SXM5, 700 W), per GPU:
the one place the port's bounds and rooflines read them
(``kernels.ops``'s kernel bounds, ``launch.analysis``'s step floor)."""
from __future__ import annotations

CARD = "NVIDIA H100 80GB HBM3"
BF16_FLOP_S = 989e12       # dense bf16 on the tensor cores
FP32_FLOP_S = 67e12        # float32 outside the tensor cores (strict fp32)
HBM_BYTES_S = 3.35e12
NVLINK_BYTES_S = 450e9     # NVLink 4, per direction
IB_BYTES_S = 50e9          # InfiniBand NDR, one 400 Gb/s port per GPU
HBM_CAPACITY = 80e9        # bytes: the "80 GB" the card's name states
# popcount issues 16 results per clock per SM (CUDA programming guide,
# compute capability 9.0); the SXM5 card's 132 SMs at its 1,980 MHz
# maximum SM clock, where a caller has no reading of its own card
POPC_PER_CLK_SM = 16
SMS = 132
MAX_SM_CLOCK_HZ = 1.98e9

FLOP_RATES = {"bfloat16": BF16_FLOP_S, "float16": BF16_FLOP_S,
              "float32": FP32_FLOP_S}


def popc_s(sms: int = SMS, clock_hz: float = MAX_SM_CLOCK_HZ) -> float:
    """Popcounts a second over sms SMs at clock_hz."""
    return POPC_PER_CLK_SM * sms * clock_hz
