"""Media I/O: native MJPEG video codecs and depth colormaps."""
