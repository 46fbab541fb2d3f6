"""Model code of the port: configuration, layers, attention and the dense
decoder's paged serving steps."""
