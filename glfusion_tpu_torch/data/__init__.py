"""Data of the port: NIfTI, the dataset index, the synthetic corpus, the
host loaders (numpy) and the device-side batch preprocess."""
