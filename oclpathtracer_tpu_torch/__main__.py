import sys

from oclpathtracer_tpu_torch.cli import main

sys.exit(main())
