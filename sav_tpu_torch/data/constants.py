"""ImageNet channel statistics on the 0..255 scale.

The port's own copy of ``sav_tpu/data/constants.py`` (the port imports
nothing of ``sav_tpu``).
"""

MEAN_RGB = (0.485 * 255, 0.456 * 255, 0.406 * 255)
STDDEV_RGB = (0.229 * 255, 0.224 * 255, 0.225 * 255)
