import sys

from nomad_tpu_torch.cli import main

sys.exit(main())
