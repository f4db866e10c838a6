"""The model cascade (``cascade.DiffusionCascade``)."""
