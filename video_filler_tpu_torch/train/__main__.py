import sys

from video_filler_tpu_torch.train.loop import main

if __name__ == "__main__":
    main(sys.argv[1:])
