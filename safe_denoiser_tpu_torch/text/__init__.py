from .clip_tokenizer import CLIPTokenizer

__all__ = ["CLIPTokenizer"]
