import sys

from lsbench_tpu_torch.harness.cli import main

sys.exit(main())
