"""python -m mythril_tpu_torch entry point."""
import sys

from mythril_tpu_torch.interfaces.cli import main

if __name__ == "__main__":
    sys.exit(main())
