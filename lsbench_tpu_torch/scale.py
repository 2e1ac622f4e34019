"""`python -m lsbench_tpu_torch.scale` → harness.scale (the rank-count
scaling sweep)."""

from lsbench_tpu_torch.harness.scale import main

if __name__ == "__main__":
    import sys

    sys.exit(main())
