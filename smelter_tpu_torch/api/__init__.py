"""Wire-format API schema + conversions (reference `smelter-api/`)."""
