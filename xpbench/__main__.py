import time

T0 = time.perf_counter()

import sys  # noqa: E402

from xpbench.harness import main  # noqa: E402

sys.exit(main(t0=T0))
