"""The benchmark of the PyTorch and CUDA port, ``multirate_tpu_torch``.

One run measures one cell of ``BENCHMARK.json`` (a deployment under a
traffic mix) and prints one JSON line:

    python3 -m benchmark.run --workload dat_to_cd.madi_block --seed 7 \\
        --seconds 10 --trace 0

The harness is driven by data. A cell names a configuration
(``configs/<config>.json``: the taps' design, the ratio or rate, the
types), a traffic mix (``traffic/<traffic>.json``: data, the name of the
entry that drives it and that entry's parameters), the entry
(``entries/<entry>.py``: the loop that drives the program) and, through
``BENCHMARK.json``, its per-layer metrics (``metrics/<metric>.py``: one
small reader each). The limits that decide ``correct`` are in
``limits/<cell>.json``, and each configuration's ``family`` names its
plain float64 reference in ``references/<family>.py``. A new cell is new
files and a new entry of ``BENCHMARK.json``; no file here is edited.
``generator.py`` holds what the entries share: the measured window and
the outcome they return.

The shared yardstick: ``designs.py`` (the taps, a numpy copy of the
windowed-sinc design), ``work.py`` (bytes and multiply-adds from shapes,
the card's published peaks), ``stats.py`` (the percentile over all
samples, the run-to-run spread), ``trace.py`` (the profiler's events, the
device's busy and idle time) and ``check.py`` (the comparison with the
reference). Nothing here imports JAX or the JAX package; the port is
imported only through its public names.
"""
