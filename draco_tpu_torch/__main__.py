"""``python -m draco_tpu_torch {run,lint,makeproducts} ...``: the pipeline CLI.

Runs on the first CUDA card; ``--platform cpu`` runs on the CPU.
"""

from .core.pipeline import main

if __name__ == "__main__":
    raise SystemExit(main())
