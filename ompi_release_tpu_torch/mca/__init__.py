"""MCA analogue: typed config variables, pvars, framework/component system."""

from .var import VARS, VarLevel, VarScope, VarSource, get, parse_size, register, set_value
from .pvar import PVARS, Pvar, PvarClass, counter, highwatermark, timer
from .component import FRAMEWORKS, Component, Framework, framework

__all__ = [
    "VARS", "VarLevel", "VarScope", "VarSource", "get", "parse_size",
    "register", "set_value",
    "PVARS", "Pvar", "PvarClass", "counter", "highwatermark", "timer",
    "FRAMEWORKS", "Component", "Framework", "framework",
]
