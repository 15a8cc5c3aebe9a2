"""``python -m glfusion_tpu_torch``: see :mod:`glfusion_tpu_torch.cli`."""

from glfusion_tpu_torch.cli import main

raise SystemExit(main())
