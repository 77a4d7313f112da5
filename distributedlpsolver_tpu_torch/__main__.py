"""``python -m distributedlpsolver_tpu_torch ...``: the command-line driver
(:mod:`distributedlpsolver_tpu_torch.cli`)."""

import sys

from distributedlpsolver_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
