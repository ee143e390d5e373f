from felics_tpu_torch.io.images import UnsupportedImageFormat, load_image, save_image

__all__ = ["UnsupportedImageFormat", "load_image", "save_image"]
