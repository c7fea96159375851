"""One torch CPU thread in every port test process (jax-free).

Every ``tests/test_torch_*.py`` imports this module before anything else,
so the pin holds whichever file a worker collects first.  The port's tests
run tiny shapes, which gain nothing from torch's intra-op pool; under
``pytest -n 6`` each worker would otherwise run a pool as wide as the
machine beside XLA's, and six such pools of spinning OpenMP workers on one
host slow each other far more than six times.  Subprocesses the tests
spawn (``tests/torch_ranks.py``) pass ``OMP_NUM_THREADS=1`` for the same
reason.
"""

import torch

torch.set_num_threads(1)
try:
    torch.set_num_interop_threads(1)
except RuntimeError:  # set once per process: inter-op work has already started
    pass
