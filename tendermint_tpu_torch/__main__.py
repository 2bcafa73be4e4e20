"""`python -m tendermint_tpu_torch` entry point (ref: cmd/tendermint/main.go)."""

import sys

from .cli import main

sys.exit(main())
