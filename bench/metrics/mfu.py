"""mfu (%): the model FLOPs a round needs (the driver's count from the
shapes: 3 forward passes a trained sample, 1 a feature pass; padding and
recomputation not counted) over the round's wall time (host clock, the
traced window's mean) at the card's float32 peak, 67 TFLOP/s."""
from bench.roofline.peaks import PEAK_FP32_FLOPS


def read(ctx):
    if not ctx.flops_per_round:
        return None
    return 100.0 * ctx.flops_per_round / (ctx.round_s * PEAK_FP32_FLOPS)
