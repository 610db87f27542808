"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its full 700 W power limit): float32 outside the tensor cores
(every configuration of this benchmark runs fp32 with TF32 off) and HBM3
bandwidth.  A run prints the card's power limit beside every share of
these."""
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def bound_s(nbytes: float, nops: float,
            peak_flops: float = PEAK_FP32_FLOPS) -> float:
    """The least time of a call: the larger of its bytes (each input read
    once, each output written once) over the bandwidth and its operations
    over the peak of their type."""
    return max(nbytes / PEAK_BYTES_PER_S, nops / peak_flops)
