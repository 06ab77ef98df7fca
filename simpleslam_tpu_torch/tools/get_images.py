"""Webcam frame grabber for calibration (the counterpart of
``simpleslam_tpu/tools/get_images.py``): SPACE saves the frame as
``<out>/img<n>.png``, ESC quits. Host tooling through cv2 (a camera and a
display are needed).

Usage: python -m simpleslam_tpu_torch.tools.get_images [--out images]
       [--camera 0]
"""
from __future__ import annotations

import argparse
import os


def main(argv=None) -> int:
    p = argparse.ArgumentParser("get_images")
    p.add_argument("--out", default="images")
    p.add_argument("--camera", type=int, default=0)
    a = p.parse_args(argv)

    import cv2

    os.makedirs(a.out, exist_ok=True)
    cap = cv2.VideoCapture(a.camera)
    n = 0
    while cap.isOpened():
        ok, frame = cap.read()
        if not ok:
            break
        k = cv2.waitKey(5)
        if k == 27:                     # ESC
            break
        if k == 32:                     # SPACE
            path = os.path.join(a.out, f"img{n}.png")
            cv2.imwrite(path, frame)
            print(f"saved {path}")
            n += 1
        cv2.imshow("capture (SPACE=save, ESC=quit)", frame)
    cap.release()
    cv2.destroyAllWindows()
    print(f"{n} images saved")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
