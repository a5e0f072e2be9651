"""registration subpackage of the PyTorch port."""
