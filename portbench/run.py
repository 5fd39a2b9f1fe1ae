"""Run one cell of the port's benchmark: ``python3 portbench/run.py --workload
<name> --seed <n> --seconds <s> --trace <0|1>`` from the repository's root."""

import os
import sys
from pathlib import Path

# one thread for the math libraries' pools: the benchmark is one process
# stepping the port, and idle pool threads would only compete with it
for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(var, "1")

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench.bench import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
