"""Image data at the host boundary: the native JPEG/YCbCr codec binding
(``native_codec``), PNG (``png``), the training and inference datasets and the loader (``pipeline``) and
the photo pair the checks and tests stylize."""
