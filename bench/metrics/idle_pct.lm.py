"""idle_pct.lm (%): ``idle_pct`` of the LM cell, over a whole launcher
call's wall (``lm_call_s``)."""
from bench.harness.spec import load_metric

read = load_metric("idle_pct").read
