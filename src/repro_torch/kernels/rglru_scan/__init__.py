from .ops import *
