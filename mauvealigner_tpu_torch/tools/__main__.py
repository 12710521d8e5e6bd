from mauvealigner_tpu_torch.tools.cli import main

raise SystemExit(main())
