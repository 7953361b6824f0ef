"""Products and bytes of a model's parts, counted from its configuration's shapes."""
