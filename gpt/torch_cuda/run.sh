# The JAX run.sh rings the sequence over 4 devices (--sp 4). With 4 GPUs:
#   torchrun --nproc-per-node 4 train.py --sp 4 -b 8 --seq-len 512 --attn-impl flash -c ./ckpt-lm
# This runs the same batch and sequence on one card, unsharded, with the
# flash kernels (K2/K3).
python train.py -b 8 --seq-len 512 --attn-impl flash -c ./ckpt-lm
