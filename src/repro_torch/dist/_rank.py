"""Entry point of one rank process started by ``dist.launch.run_ranks``:
``python -m repro_torch.dist._rank <work dir> <rank>``."""

import sys

from repro_torch.dist.launch import _rank_main

if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]))
