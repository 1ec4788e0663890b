"""TUM-VI entry point (ref src/bin/run_tum.rs):

    python -m rsvio_tpu_torch.cli.run_tum <config.yaml> <dataset> [--device cpu]
"""

import sys

from ..data.players import TUMVIPlayer
from .run import make_cli

main = make_cli(TUMVIPlayer, "TUM-VI")

if __name__ == "__main__":
    sys.exit(main())
