from .cli import parse_option, str_or_float

__all__ = ["parse_option", "str_or_float"]
