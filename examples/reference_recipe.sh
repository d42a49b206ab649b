#!/usr/bin/env bash
# The reference's exact published recipe, one command away (VERDICT r1 #3b).
#
# Encodes /root/reference/README.md:15-19 + utils/parameters.py:3-29:
# Normal-prior CVAE with cluster vectors, NO fine-tuning — "the best
# achieved result with using cluster vectors without fine-tuning is
# CIDER~0.8".  Defaults already match the reference (20 epochs, Adam
# lr 5e-4 β1=0.8, batch 32, latent 150, 100 z-samples, embed 256,
# LSTM 512, ~120k train images via gen_val_captions=4000); this script
# only pins the recipe-specific choices and runs train → beam-10
# inference → CIDEr scoring with the validated in-repo scorer.
#
# Usage:
#   examples/reference_recipe.sh /path/to/mscoco [vgg16_weights.npz] [run_name]
#
# Expects the standard COCO layout under $COCO_DIR:
#   annotations/captions_{train,val}2014.json
#   annotations/instances_train2014.json  (cluster vectors)
#   images/{train2014,val2014}/*.jpg
#
# RECIPE_EXTRA_ARGS (env, optional): extra CLI args appended to BOTH the
# train and inference invocations — used by tests/test_recipe.py to run
# this exact script against the synthetic mini-COCO with tiny dims
# (e.g. "--epochs 1 --bs 4 --set embed_size=32 ...") so the eventual
# real-data run cannot die on recipe mechanics (VERDICT r2 #1b).  Leave
# unset for the real reference recipe.
set -euo pipefail

COCO_DIR="${1:?usage: reference_recipe.sh COCO_DIR [VGG_NPZ] [RUN_NAME]}"
VGG_NPZ="${2:-./vgg16_weights.npz}"
RUN="${3:-normal_cv_ref}"
read -r -a EXTRA <<< "${RECIPE_EXTRA_ARGS:-}"

# 1. train: Normal prior + cluster vectors, reference defaults
python -m vae_captioning.cli \
  --coco_dir "$COCO_DIR" \
  --c_v --prior Normal \
  --checkpoint "$RUN" --gen_name "$RUN" \
  --set image_net_weights_path="$VGG_NPZ" \
  ${EXTRA[@]+"${EXTRA[@]}"}

# 2. inference: beam search, beam 10 ("set according to papers baselines",
#    utils/parameters.py:16-18) → val_${RUN}.json / test_${RUN}.json
python -m vae_captioning.cli --mode inference \
  --coco_dir "$COCO_DIR" \
  --c_v --prior Normal \
  --checkpoint "$RUN" --gen_name "$RUN" \
  --sample_gen beam_search --set beam_size=10 \
  ${EXTRA[@]+"${EXTRA[@]}"}

# 3. score the val split against ground truth (PTB-tokenized BLEU-1..4 +
#    CIDEr-D, validated against nltk / hand-derived constants in
#    tests/test_eval.py) — compare CIDEr-D to the reference's ~0.8
python -m vae_captioning.eval.scorers \
  --results "val_${RUN}.json" \
  --annotations "$COCO_DIR/annotations/captions_val2014.json"
