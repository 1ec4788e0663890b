"""EuRoC entry point (ref src/bin/run_euroc.rs):

    python -m rsvio_tpu_torch.cli.run_euroc <config.yaml> <dataset> [--device cpu]
"""

import sys

from ..data.players import EurocPlayer
from .run import make_cli

main = make_cli(EurocPlayer, "EuRoC")

if __name__ == "__main__":
    sys.exit(main())
