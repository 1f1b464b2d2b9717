"""The benchmark's CT-like volume under its former name: the volume is
`volumes/ct_phantom.py` (a configuration's ``"volume": "ct_phantom"``)."""

from .volumes.ct_phantom import make as ct_phantom

__all__ = ["ct_phantom"]
