"""``python3 -m hdbench``: see ``hdbench/run.py``."""

import sys

from hdbench.run import main

sys.exit(main())
