"""`python -m ray_tracing_tpu_torch --scene ... --output ...`"""

import sys

from ray_tracing_tpu_torch.apps.cli import main

sys.exit(main())
