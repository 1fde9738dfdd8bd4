"""GPT-judge scorer for the QA benchmark outputs (the port's copy of
``videotgb_tpu/evalsuite/evaluate.py``, same prompts, files and scores).

Port of the reference's resumable multi-process judge (reference:
eval/evaluate.py:30-217): each {'question','answer','pred'} row is scored by
gpt-3.5-turbo with the exact same system/user prompt, yielding
{'pred': 'yes'|'no', 'score': 0-5}; one json file per QA id makes the run
resumable by diffing the output directory; final accuracy = yes/(yes+no) and
mean score.

Judge backends:
  * "openai"      - the reference protocol (needs the openai package and
                    OPENAI_API_KEY, imported only when this judge runs);
  * "token_recall"- offline: rouge_n recall thresholding, useful for smoke
                    tests and relative comparisons only.

    python -m videotgb_torch.evalsuite.evaluate --pred_path preds.json \
        --output_dir judged --judge token_recall
"""

from __future__ import annotations

import argparse
import ast
import json
import os
from concurrent.futures import ThreadPoolExecutor

from videotgb_torch.training.metrics import rouge_n

SYSTEM_PROMPT = (
    "You are an intelligent chatbot designed for evaluating the correctness "
    "of generative outputs for question-answer pairs. Your task is to compare "
    "the predicted answer with the correct answer and determine if they match "
    "meaningfully. Here's how you can accomplish the task:"
    "------"
    "##INSTRUCTIONS: "
    "- Focus on the meaningful match between the predicted answer and the "
    "correct answer.\n"
    "- Consider synonyms or paraphrases as valid matches.\n"
    "- Evaluate the correctness of the prediction compared to the answer."
)


def user_prompt(question: str, answer: str, pred: str) -> str:
    return (
        "Please evaluate the following video-based question-answer pair:\n\n"
        f"Question: {question}\n"
        f"Correct Answer: {answer}\n"
        f"Predicted Answer: {pred}\n\n"
        "Provide your evaluation only as a yes/no and score where the score "
        "is an integer value between 0 and 5, with 5 indicating the highest "
        "meaningful match. Please generate the response in the form of a "
        "Python dictionary string with keys 'pred' and 'score', where value "
        "of 'pred' is  a string of 'yes' or 'no' and value of 'score' is in "
        "INTEGER, not STRING."
        "DO NOT PROVIDE ANY OTHER OUTPUT TEXT OR EXPLANATION. Only provide "
        "the Python dictionary string. "
        "For example, your response should look like this: "
        "{'pred': 'yes', 'score': 4.8}."
    )


def judge_openai(qa: dict, api_key: str | None, api_base: str | None) -> dict:
    import openai

    client = openai.OpenAI(api_key=api_key, base_url=api_base or None)
    completion = client.chat.completions.create(
        model="gpt-3.5-turbo",
        messages=[
            {"role": "system", "content": SYSTEM_PROMPT},
            {"role": "user",
             "content": user_prompt(qa["q"], qa["a"], qa["pred"])},
        ],
    )
    return ast.literal_eval(completion.choices[0].message.content)


def judge_token_recall(qa: dict) -> dict:
    """Offline heuristic: recall of gold tokens in the prediction."""
    score = rouge_n(qa["a"], qa["pred"])
    return {"pred": "yes" if score >= 0.5 else "no",
            "score": round(score * 5)}


def annotate(prediction_set: dict, keys: list[str], output_dir: str, args) -> None:
    for key in keys:
        qa = prediction_set[key]
        try:
            if args.judge == "openai":
                result = judge_openai(qa, args.api_key, args.api_base)
            else:
                result = judge_token_recall(qa)
            with open(os.path.join(output_dir, f"{key}.json"), "w") as f:
                json.dump([result, qa], f)
        except Exception as e:  # resumable: failures retried next sweep
            print(f"Error processing '{key}': {e}")


def load_predictions(pred_path: str) -> dict[str, dict]:
    with open(pred_path) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    out = {}
    for row in rows:
        pred = row["pred"].split("</s>")[0]  # evaluate.py:125
        out[str(row["id"])] = {"q": row["question"], "a": row["answer"],
                               "pred": pred}
    return out


def combine_and_score(output_dir: str, output_json: str | None = None) -> dict:
    """Merge per-id judgments and compute accuracy + mean score
    (evaluate.py:163-212; eval/debug.py recompute path)."""
    combined = {}
    for name in os.listdir(output_dir):
        if name.endswith(".json"):
            with open(os.path.join(output_dir, name)) as f:
                combined[name[:-5]] = json.load(f)
    if output_json:
        with open(output_json, "w") as f:
            json.dump(combined, f)
    score_sum = count = yes = no = 0
    for result, _ in combined.values():
        try:
            count += 1
            score_sum += int(result["score"])
            pred = str(result["pred"]).lower()
            if "yes" in pred:
                yes += 1
            elif "no" in pred:
                no += 1
        except Exception:
            continue
    return {
        "yes_count": yes,
        "no_count": no,
        "accuracy": yes / max(yes + no, 1),
        "average_score": score_sum / max(count, 1),
        "count": count,
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--pred_path", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--output_json", default=None)
    p.add_argument("--num_tasks", type=int, default=8)
    p.add_argument("--api_key", default=os.environ.get("OPENAI_API_KEY"))
    p.add_argument("--api_base", default=None)
    p.add_argument("--judge", choices=["openai", "token_recall"],
                   default="openai")
    args = p.parse_args(argv)

    prediction_set = load_predictions(args.pred_path)
    os.makedirs(args.output_dir, exist_ok=True)

    # resumable sweep loop (evaluate.py:134-158)
    for _ in range(64):
        done = {f[:-5] for f in os.listdir(args.output_dir) if f.endswith(".json")}
        todo = [k for k in prediction_set if k not in done]
        if not todo:
            break
        n = min(args.num_tasks, len(todo))
        parts = [todo[i::n] for i in range(n)]
        with ThreadPoolExecutor(n) as pool:
            list(pool.map(
                lambda part: annotate(prediction_set, part, args.output_dir, args),
                parts))

    stats = combine_and_score(args.output_dir, args.output_json)
    for k, v in stats.items():
        print(f"{k}: {v}")
    return stats


if __name__ == "__main__":
    main()
