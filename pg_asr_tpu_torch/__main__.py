"""``python -m pg_asr_tpu_torch --mode predict ...`` (see cli.py)."""

from .cli import main

if __name__ == "__main__":
    raise SystemExit(main())
