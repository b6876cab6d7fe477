"""``python -m deepaco_tpu_torch test tsp --sparse ...`` (see :mod:`.cli`)."""
from deepaco_tpu_torch.cli import main

if __name__ == "__main__":
    main()
