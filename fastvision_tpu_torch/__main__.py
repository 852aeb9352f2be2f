"""``python -m fastvision_tpu_torch train|eval|infer ...`` (see `cli`)."""
from .cli import main

if __name__ == "__main__":
    main()
