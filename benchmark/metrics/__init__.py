"""One reader per metric, named as the metric (`core.load_reader`)."""
