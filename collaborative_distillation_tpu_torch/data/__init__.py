"""Image data at the host boundary: the native JPEG/YCbCr codec binding
(``native_codec``) and the photo pair the checks and tests stylize."""
