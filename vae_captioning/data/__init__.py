from vae_captioning.data.tokenizer import tokenize_caption  # noqa: F401
from vae_captioning.data.vocabulary import Vocabulary  # noqa: F401
from vae_captioning.data.coco import CocoCaptions  # noqa: F401
