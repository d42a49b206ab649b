"""vae_captioning — a JAX caption-generation framework for NVIDIA GPUs
with the capabilities of yiyang92/vae_captioning.

Implements the models of "Diverse and Accurate Image Description Using a
Variational Auto-Encoder with an Additive Gaussian Encoding Space"
(Wang & Schwing, NeurIPS 2017) on MS-COCO 2014:

  * VGG16 + LSTM baseline        (``no_encoder=True``)
  * Normal-prior CVAE            (``prior='Normal'``)
  * GMM-prior CVAE               (``prior='GMM'``)
  * AG-CVAE (additive Gaussian)  (``prior='AG'``)

with greedy / temperature-sampled / fully-batched on-device beam-search
decoding and COCO-eval-ready JSON output.

Everything the reference does with feed_dict loops, per-token ``sess.run``
round-trips, and host-side beam heaps is here a jitted pure function over
PyTrees: ``lax.scan`` LSTMs, on-device batched beam search, a mesh-sharded
data-parallel train step, and numpy checkpoints.

Reference layout parity (see SURVEY.md):
  config   ↔ utils/parameters.py
  data/    ↔ utils/{captions,data,batch_gen,image_utils,caption_utils}.py,
             preprocess.py, the cluster-vector notebooks
  models/  ↔ utils/image_embeddings.py, vae_model/{encoder,decoder}.py
  ops/     ↔ utils/rnn_model.py, utils/top_n.py, vae_model/decoder.py decode
  train    ↔ main.py + ops/optimizers.py
  infer    ↔ ops/inference.py
  generate ↔ gen_caption.py
"""

__version__ = "0.1.0"

from vae_captioning.config import Config  # noqa: F401
