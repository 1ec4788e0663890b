"""4Seasons entry point (ref src/bin/run_4seasons.rs):

    python -m rsvio_tpu_torch.cli.run_4seasons <config.yaml> <dataset> [--device cpu]
"""

import sys

from ..data.players import FourSeasonsPlayer
from .run import make_cli

main = make_cli(FourSeasonsPlayer, "4Seasons")

if __name__ == "__main__":
    sys.exit(main())
