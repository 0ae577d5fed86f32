python train.py -p torch_ddp_fp16 -c ./ckpt-fp16
