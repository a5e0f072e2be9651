"""odometry subpackage of the PyTorch port."""
