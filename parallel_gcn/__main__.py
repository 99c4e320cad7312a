from parallel_gcn.cli import main

raise SystemExit(main())
