"""One intra-op thread for the port's tests on the CPU.

The tier-1 command runs six pytest-xdist workers on the machine's cores,
and each worker's PyTorch opened a pool of intra-op threads as wide as the
machine, whose waits spin.  On the small tensors of these tests the six
pools took the cores from each other: a test that runs in 1.2 s alone
(``test_torch_episode_cache.py``'s reused-episode case) took 83.5 s in the
suite.  With one thread a worker the suite's summed test time halved.
Importing this module sets it for the process; every worker imports every
test file while it collects, so the whole suite runs so.
"""
import torch

torch.set_num_threads(1)
