from direct_lidar_odometry_tpu_torch.cli import main

raise SystemExit(main())
