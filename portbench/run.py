"""Run one benchmark cell of the PyTorch/CUDA port and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout on a machine with the cell's cards.
The last line of standard output is the result object; the numbers the
correctness check compared, each beside its limit, are the last lines
of standard error.
"""

import os
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from portbench.harness import main

    sys.exit(main())
