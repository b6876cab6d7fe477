"""``python -m acobench --workload <cell> --seed <n> --seconds <s> --trace <0|1>``."""
import sys

from acobench.run import main

sys.exit(main())
