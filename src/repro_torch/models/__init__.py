"""Dense decoder model of the PyTorch port: config, layers, attention and the
transformer stack."""
