import sys
import time

t_start = time.perf_counter()

from masabench.run import main  # noqa: E402  (the set-up's clock runs first)

sys.exit(main(t_start=t_start))
