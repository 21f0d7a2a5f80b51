from . import mpu, utils

__all__ = ["mpu", "utils"]
