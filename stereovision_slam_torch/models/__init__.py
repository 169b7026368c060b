"""Place-recognition embedders of the loop-closure path."""
