"""mfu.lm (%): ``mfu`` of the LM cell, whose round is a whole launcher
call (``lm_call_s``): the model FLOPs of the call's round over its wall
at the card's float32 peak."""
from bench.harness.spec import load_metric

read = load_metric("mfu").read
