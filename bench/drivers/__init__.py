"""One driver per kind of entry that a cell's ``entry`` names.  A driver
module defines ``Driver(cell, config, seed, device)`` with ``setup()``,
``run_round()``, ``close_program()``, ``check()``, ``flops_per_round()``,
``range_names`` and ``context()``; ``bench/run.py`` drives it."""
