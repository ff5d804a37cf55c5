"""Port of ``repro.models``: the dense decoder, its layers and attention."""
