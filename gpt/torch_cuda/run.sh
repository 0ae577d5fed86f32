# The JAX run.sh rings the sequence over 4 devices (--sp 4), which the
# port lacks; this runs the same batch and sequence on one card, with the
# flash kernels (K2/K3). Under torchrun: torchrun --nproc-per-node 1 train.py ...
python train.py -b 8 --seq-len 512 --attn-impl flash -c ./ckpt-lm
