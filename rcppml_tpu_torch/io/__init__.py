"""The .spz codec, the R data reader and the panel loaders of the port."""
