"""Image data at the host boundary: JPEG by device (``jpeg``: nvJPEG on the
card, ``nvjpeg_codec``; libjpeg on the host, ``native_codec``, which also
has the YCbCr converters), JPEG headers (``jpeg_header``), PNG (``png``),
the training and inference datasets and the loader (``pipeline``), the
photo pair the checks and tests stylize and the JPEG fixture the card's
codec is held to."""
