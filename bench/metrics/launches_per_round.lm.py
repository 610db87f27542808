"""launches_per_round.lm (launches): ``launches_per_round`` of the LM
cell, in a whole launcher call (``lm_call_s``)."""
from bench.harness.spec import load_metric

read = load_metric("launches_per_round").read
