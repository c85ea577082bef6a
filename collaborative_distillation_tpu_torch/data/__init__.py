"""Image data at the host boundary: JPEG by device (``jpeg``: nvJPEG on the
card, ``nvjpeg_codec``; libjpeg on the host, ``native_codec``, which also
has the YCbCr converters), JPEG headers (``jpeg_header``), PNG (``png``),
the training and inference datasets and the loader (``pipeline``), the
photo pair the checks and tests stylize and the JPEG fixture the card's
codec is held to."""

# the pipeline's names, exported lazily: ``utils.image`` imports this package
# for its codecs, and the pipeline imports ``utils.image``
__all__ = ["CenterCropDataset", "ContentStylePairDataset", "ImageFolderDataset", "Loader",
           "NpyFolderDataset", "PairGridDataset", "is_img", "load_image", "resize_shorter_side"]


def __getattr__(name):
    if name in __all__:
        from . import pipeline
        return getattr(pipeline, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
