"""Convert a 4Seasons GNSSPoses.txt ground-truth file to TUM format.

Port of tools/gnss_to_tum.py over rsvio_tpu_torch.utils.trajectory. The
output feeds rsvio_tpu_torch.tools.evaluate_ate.

Usage: python -m rsvio_tpu_torch.tools.gnss_to_tum <GNSSPoses.txt> <out.tum>
"""

from __future__ import annotations

import sys

from ..utils.trajectory import gnss_to_tum


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 2:
        print(__doc__)
        return 2
    n = gnss_to_tum(argv[0], argv[1])
    print(f"wrote {n} poses -> {argv[1]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
