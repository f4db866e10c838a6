"""Work counts of the port's built steps and their roofline at H100 peaks
(port of ``repro/analysis``: ``count.py`` stands for ``hlo.py``)."""
