"""Hendrycks MMLU taxonomy: 57 subjects -> topics -> 4 macro categories,
and the category-level accuracy rollup (port of
mobilefinetuner_tpu/eval/mmlu_categories.py, the same table and rollup).

The taxonomy is public dataset metadata from the MMLU paper's evaluation
code (reference vendors it at data/mmlu/hendrycks_test/categories.py:
`subcategories` maps each subject to a topic, `categories` groups topics
into STEM / humanities / social sciences / other); the reference's own
category report comes from evaluate.py's rollup. Subjects outside the
official 57 (custom CSVs) report under "uncategorized" rather than being
dropped or misfiled.
"""

from __future__ import annotations

from typing import Dict, List

# subject -> topic (the paper's "subcategory")
SUBJECT_TOPICS: Dict[str, str] = {
    "abstract_algebra": "math",
    "anatomy": "health",
    "astronomy": "physics",
    "business_ethics": "business",
    "clinical_knowledge": "health",
    "college_biology": "biology",
    "college_chemistry": "chemistry",
    "college_computer_science": "computer science",
    "college_mathematics": "math",
    "college_medicine": "health",
    "college_physics": "physics",
    "computer_security": "computer science",
    "conceptual_physics": "physics",
    "econometrics": "economics",
    "electrical_engineering": "engineering",
    "elementary_mathematics": "math",
    "formal_logic": "philosophy",
    "global_facts": "other",
    "high_school_biology": "biology",
    "high_school_chemistry": "chemistry",
    "high_school_computer_science": "computer science",
    "high_school_european_history": "history",
    "high_school_geography": "geography",
    "high_school_government_and_politics": "politics",
    "high_school_macroeconomics": "economics",
    "high_school_mathematics": "math",
    "high_school_microeconomics": "economics",
    "high_school_physics": "physics",
    "high_school_psychology": "psychology",
    "high_school_statistics": "math",
    "high_school_us_history": "history",
    "high_school_world_history": "history",
    "human_aging": "health",
    "human_sexuality": "culture",
    "international_law": "law",
    "jurisprudence": "law",
    "logical_fallacies": "philosophy",
    "machine_learning": "computer science",
    "management": "business",
    "marketing": "business",
    "medical_genetics": "health",
    "miscellaneous": "other",
    "moral_disputes": "philosophy",
    "moral_scenarios": "philosophy",
    "nutrition": "health",
    "philosophy": "philosophy",
    "prehistory": "history",
    "professional_accounting": "other",
    "professional_law": "law",
    "professional_medicine": "health",
    "professional_psychology": "psychology",
    "public_relations": "politics",
    "security_studies": "politics",
    "sociology": "culture",
    "us_foreign_policy": "politics",
    "virology": "health",
    "world_religions": "philosophy",
}

# macro category -> topics
MACRO_CATEGORIES: Dict[str, List[str]] = {
    "STEM": ["physics", "chemistry", "biology", "computer science",
             "math", "engineering"],
    "humanities": ["history", "philosophy", "law"],
    "social sciences": ["politics", "culture", "economics", "geography",
                        "psychology"],
    "other (business, health, misc.)": ["other", "business", "health"],
}

UNCATEGORIZED = "uncategorized"

_TOPIC_TO_MACRO = {topic: macro
                   for macro, topics in MACRO_CATEGORIES.items()
                   for topic in topics}


def subject_macro_category(subject: str) -> str:
    """Macro category for a subject; UNCATEGORIZED for non-official ones."""
    topic = SUBJECT_TOPICS.get(subject)
    return _TOPIC_TO_MACRO.get(topic, UNCATEGORIZED) if topic \
        else UNCATEGORIZED


def category_rollup(result) -> Dict[str, dict]:
    """Per-macro-category accuracies from an MMLUResult: macro (mean of the
    member subjects' accuracies — the paper's headline aggregation) and
    micro (pooled over items), plus counts. Categories with no evaluated
    subjects are omitted."""
    groups: Dict[str, list] = {}
    for r in result.per_subject:
        groups.setdefault(subject_macro_category(r.subject), []).append(r)
    out = {}
    for cat in list(MACRO_CATEGORIES) + [UNCATEGORIZED]:
        rs = groups.get(cat)
        if not rs:
            continue
        total = sum(r.total for r in rs)
        out[cat] = {
            "macro_accuracy": round(
                sum(r.accuracy for r in rs) / len(rs), 4),
            "micro_accuracy": round(
                sum(r.correct for r in rs) / total, 4) if total else 0.0,
            "subjects": len(rs),
            "correct": sum(r.correct for r in rs),
            "total": total,
        }
    return out
