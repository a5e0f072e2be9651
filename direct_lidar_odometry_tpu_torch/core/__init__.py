"""core subpackage of the PyTorch port."""
