"""Image data at the host boundary: the native JPEG/YCbCr codec binding
(``native_codec``), PNG (``png``), the inference datasets (``pipeline``) and
the photo pair the checks and tests stylize."""
